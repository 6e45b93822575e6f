"""Transport-neutral message model — a copy of
:mod:`tpfl.communication.message`.

One dataclass that the in-memory transport passes by reference and a
byte transport frames as a msgpack envelope (pickle-free). The envelope
goes through the port's own MessagePack subset
(:mod:`tpfl_torch.learning._msgpack`), byte-equal to the reference's
``msgpack.packb(..., use_bin_type=True)``.
"""

from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass, field
from typing import Optional

from tpfl_torch.learning import _msgpack

_counter = itertools.count()
_counter_lock = threading.Lock()


def _next_uid() -> int:
    with _counter_lock:
        return next(_counter)


@dataclass
class Message:
    """One protocol datagram: either a control message (args + ttl) or a
    weights transfer (payload + contributors + num_samples)."""

    source: str
    cmd: str
    round: int = -1
    args: list[str] = field(default_factory=list)
    ttl: int = 0
    msg_hash: str = ""
    payload: Optional[bytes] = None
    contributors: list[str] = field(default_factory=list)
    num_samples: int = 0
    # Immediate relayer (≠ source once forwarded): lets the TTL flood
    # skip the hop it came from. Set by the transport at send time.
    via: str = ""
    # Hop-tracing id mirrored from a traced weights payload (empty while
    # telemetry is off; the port's tracing is a gate, see
    # tpfl_torch.management.tracing).
    trace: str = ""
    # Model-version ordinal a weights contribution was trained FROM
    # (async buffered rounds); -1 = untagged (sync payloads).
    version: int = -1

    @property
    def is_weights(self) -> bool:
        return self.payload is not None

    def new_hash(self) -> "Message":
        """Unique id for gossip dedup: a process-unique counter
        (collision free and deterministic)."""
        self.msg_hash = f"{self.source}#{_next_uid()}"
        return self

    # --- wire format ---

    def to_bytes(self) -> bytes:
        if self.payload is not None and not isinstance(
            self.payload, (bytes, bytearray, memoryview)
        ):
            # An InprocModelRef must never cross a process boundary —
            # only the in-memory transport (which passes the Message
            # object itself) may carry one.
            raise TypeError(
                f"by-reference payload ({type(self.payload).__name__}) "
                "cannot be wire-framed; encode it first"
            )
        return _msgpack.packb(
            {
                "src": self.source,
                "cmd": self.cmd,
                "rnd": self.round,
                "args": [str(a) for a in self.args],
                "ttl": self.ttl,
                "h": self.msg_hash,
                "w": self.payload,
                "c": self.contributors,
                "n": self.num_samples,
                "v": self.via,
                "t": self.trace,
                "mv": self.version,
            }
        )

    @classmethod
    def from_bytes(cls, raw: bytes) -> "Message":
        d = _msgpack.unpackb(raw)
        return cls(
            source=d["src"],
            cmd=d["cmd"],
            round=d["rnd"],
            args=list(d["args"]),
            ttl=d["ttl"],
            msg_hash=d["h"],
            payload=d["w"],
            contributors=list(d["c"]),
            num_samples=d["n"],
            via=d.get("v", ""),
            trace=d.get("t", ""),
            version=d.get("mv", -1),
        )
