"""RANK_CONTRACTS runtime half: per-process program-dispatch receipts —
the port of :mod:`tpfl.parallel.ranksafe`.

Ranks that take the same code path may still resolve DIFFERENT programs
(a knob read racing a config push, a cache key derived from host-local
state); the first collective would then hang the world. When
``Settings.RANK_CONTRACTS`` is on, every engine window dispatch appends
one entry to an ordered per-process log: the digest of the program's
cache key plus a fingerprint of the program. The crosshost harness
stamps the log into each worker's receipt (``program_digests``) and
:func:`compare_receipts` fails the launch with the first divergent
(rank, ordinal, key) witness.

The port has no lowered HLO, so its fingerprint
(:func:`hlo_fingerprint`) is taken over the text it does have: the
program's description, the cache key's fields plus the hashes of the
kernel libraries ``tpfl_torch.parallel._build`` loaded in this process.
Two ranks agreeing on the key but running different kernel builds still
diverge.

Pure stdlib on purpose: the parent orchestrator
(:func:`tpfl_torch.parallel.crosshost.launch`) compares receipts without
importing torch.
"""

from __future__ import annotations

import hashlib
from typing import Any

__all__ = [
    "RankContractError",
    "clear",
    "compare_receipts",
    "receipt",
    "record_dispatch",
]

#: Bounded dispatch log (single-owner like the engine's program
#: caches: one process, one engine-driving thread). The cap is a
#: leak guard for long in-process test sessions, far above any one
#: harness run's dispatch count.
_LOG_CAP = 65536
_log: "list[dict]" = []
_ordinal = 0


class RankContractError(RuntimeError):
    """Cross-rank program-sequence divergence, with the first
    divergent (rank, ordinal, key) as the witness."""


def record_dispatch(key: Any, hlo_fingerprint: str = "") -> None:
    """Append one dispatched program to this process's ordered log.

    ``key`` is the engine's program cache key (any reprable value);
    ``hlo_fingerprint`` the program description's digest — two ranks
    agreeing on the key but running different kernel builds still
    diverge."""
    global _ordinal
    digest = hashlib.sha256(
        f"{key!r}|{hlo_fingerprint}".encode()
    ).hexdigest()[:16]
    if len(_log) < _LOG_CAP:
        _log.append(
            {"ordinal": _ordinal, "key": repr(key), "digest": digest}
        )
    _ordinal += 1


def receipt() -> "list[dict]":
    """The ordered dispatch log (copies — safe to serialize)."""
    return [dict(e) for e in _log]


def clear() -> None:
    """Reset the log (harness entry points call this so a receipt
    covers exactly one run)."""
    global _ordinal
    _log.clear()
    _ordinal = 0


def hlo_fingerprint(text: str) -> str:
    """Digest of a program's text description."""
    return hashlib.sha256(text.encode()).hexdigest()[:16]


def compare_receipts(receipts: "list[list[dict]]") -> None:
    """All-ranks agreement check over per-rank dispatch logs.

    Raises :class:`RankContractError` naming the first (rank, ordinal,
    key) where a rank's sequence diverges from rank 0's — a missing,
    extra, or different program."""
    if not receipts:
        return
    base = receipts[0]
    for rank, seq in enumerate(receipts[1:], start=1):
        for i in range(max(len(base), len(seq))):
            a = base[i] if i < len(base) else None
            b = seq[i] if i < len(seq) else None
            if a is not None and b is not None and a["digest"] == b["digest"]:
                continue
            witness = b if b is not None else a
            what = (
                "dispatched extra program" if a is None
                else "missing dispatch" if b is None
                else "dispatched different program"
            )
            raise RankContractError(
                f"rank {rank} diverged from rank 0 at dispatch ordinal "
                f"{i}: {what} (key {witness['key']}, rank0="
                f"{a['digest'] if a else '<none>'}, rank{rank}="
                f"{b['digest'] if b else '<none>'}) — every process "
                "must issue the identical SPMD program sequence"
            )
