"""Hop-level distributed tracing — a copy of :mod:`tpfl.management.tracing`.

A 16-byte trace id is minted when a model payload is first encoded
(``communication.base.model_payload`` — the one sanctioned
payload-producing seam) and embedded in the payload itself: the v3
envelope header gains a ``tid`` key (v1/v2 decoders ignore unknown map
keys), the v1/v2 envelopes carry the same key, and the in-proc
:class:`~tpfl_torch.learning.serialization.InprocModelRef` carries it as
an attribute. Because the FullModel epidemic relay forwards payload
BYTES verbatim, the id follows the payload across every hop with zero
re-encoding — which is what lets ``tools/traceview.py`` reconstruct a
payload's full path (encode → send/retries → recv → decode → fold)
across nodes.

The transport envelope (:class:`~tpfl_torch.communication.message.Message`)
mirrors the id in its ``trace`` field so the shared send/receive paths
can tag hop spans without touching payload bytes.

Everything here is gated by ``Settings.TELEMETRY_ENABLED``:
:func:`maybe_span` returns a shared no-op context manager when
tracing is off, so the instrumented hot paths pay one attribute read.
Spans use ``time.monotonic()`` and land in the per-node
:class:`~tpfl_torch.management.telemetry.FlightRecorder` ring.

Trace ids are DETERMINISTIC for a fixed seed: id ``n`` minted by node
``a`` is ``sha256(SEED | a | n)[:16]`` — the reference's ids, so the
same seeded federation mints the same id sequence per node in both
packages. The payload peek unpacks msgpack through the port's
:mod:`tpfl_torch.learning._msgpack`.
"""

from __future__ import annotations

import hashlib
import struct
import time
from typing import Any, Optional

from tpfl_torch.concurrency import make_lock
from tpfl_torch.learning import _msgpack
from tpfl_torch.management.telemetry import flight
from tpfl_torch.settings import Settings


def enabled() -> bool:
    return bool(Settings.TELEMETRY_ENABLED)


class _Minter:
    """Deterministic per-node trace/span id sequences."""

    def __init__(self) -> None:
        self._lock = make_lock("_Minter._lock")
        # guarded-by: _lock
        self._counters: dict[str, int] = {}

    def next_id(self, node: str) -> str:
        with self._lock:
            n = self._counters.get(node, 0) + 1
            self._counters[node] = n
        seed = Settings.SEED if Settings.SEED is not None else 0
        return hashlib.sha256(f"{seed}|{node}|{n}".encode()).hexdigest()[:32]

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()


_minter = _Minter()
_span_seq = _Minter()  # span ordinals share the mechanism, not the ids


def mint(node: str) -> str:
    """A fresh 16-byte (32 hex chars) trace id for ``node``."""
    return _minter.next_id(node)


def reset() -> None:
    """Restart the deterministic id sequences (tests / bench A-B)."""
    _minter.reset()
    _span_seq.reset()


class _Span:
    """An open span; closes into the node's flight-recorder ring."""

    __slots__ = ("_entry",)

    def __init__(self, name: str, node: str, trace: str, attrs: dict) -> None:
        # unguarded: a span is owned by the thread that opened it until
        # __exit__ hands the finished dict to the flight ring.
        self._entry = {
            "kind": "span",
            "name": name,
            "node": node,
            "trace": trace,
            "span": _span_seq.next_id(node)[:16],
            "t0": time.monotonic(),
            **attrs,
        }

    def set(self, **attrs: Any) -> None:
        """Attach attributes mid-span (attempt counts, byte sizes)."""
        self._entry.update(attrs)

    def __enter__(self) -> "_Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self._entry["t1"] = time.monotonic()
        if exc is not None:
            self._entry["error"] = f"{type(exc).__name__}: {exc}"[:200]
        flight.record(self._entry["node"], self._entry)


class _NullSpan:
    """Shared no-op stand-in when tracing is off."""

    __slots__ = ()

    def set(self, **attrs: Any) -> None:
        pass

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc: object) -> None:
        pass


_NULL = _NullSpan()


def maybe_span(
    name: str, node: str, trace: str = "", **attrs: Any
) -> "_Span | _NullSpan":
    """A context-managed span when ``Settings.TELEMETRY_ENABLED``,
    else the shared no-op."""
    if not Settings.TELEMETRY_ENABLED:
        return _NULL
    return _Span(name, node, trace, attrs)


def event(name: str, node: str, trace: str = "", **attrs: Any) -> None:
    """A point-in-time record (retry, breaker trip, quorum
    degradation) in the node's flight ring."""
    if not Settings.TELEMETRY_ENABLED:
        return
    flight.record(
        node,
        {
            "kind": "event",
            "name": name,
            "node": node,
            "trace": trace,
            "t": time.monotonic(),
            **attrs,
        },
    )


def export(node: Optional[str] = None) -> list[dict]:
    """Recorded spans/events (all nodes time-merged by default) — the
    in-process input to ``tools.traceview.build_timeline``."""
    return flight.snapshot(node)


# --- payload trace-id peek ------------------------------------------------
#
# Reads the embedded id back out of an encoded payload WITHOUT a full
# model decode where the layout allows: an InprocModelRef exposes it as
# an attribute, a v3 payload in its (small) msgpack header, a v2 codec
# envelope in its outer map. A v1 payload requires unpacking the whole
# map (leaf bytes and all), so it is only attempted when tracing is on
# — v1 is the legacy-interop encoder, not a hot path.


def payload_trace_id(payload: Any) -> str:
    if payload is None:
        return ""
    t = getattr(payload, "trace", None)
    if t is not None:  # InprocModelRef
        return str(t)
    if not isinstance(payload, (bytes, bytearray, memoryview)):
        return ""
    data = payload if isinstance(payload, bytes) else bytes(payload)
    try:
        lead = data[:1]
        if lead == b"\x03":
            (hlen,) = struct.unpack_from("<I", data, 1)
            if 5 + hlen > len(data):
                return ""
            header = _msgpack.unpackb(data[5: 5 + hlen])
            return str(header.get("tid", ""))
        if lead == b"\x02":
            env = _msgpack.unpackb(data[2:])
            return str(env.get("tid", ""))
        env = _msgpack.unpackb(data)
        if isinstance(env, dict):
            return str(env.get("tid", ""))
    except Exception:
        return ""
    return ""


__all__ = [
    "enabled",
    "event",
    "export",
    "maybe_span",
    "mint",
    "payload_trace_id",
    "reset",
]
