"""Per-round wall-clock attribution and the run-wide profiler trace — the
subset of :mod:`tpfl.management.profiling` that the node runtime calls:
:class:`RoundProfiler` with its process-wide :data:`rounds`, and
:func:`start_trace` / :func:`stop_trace` over ``torch.profiler``.

A round window opens in the vote stage (``begin_round``) and closes in
the round-finished stage (``end_round``). Instrumented sites accumulate
seconds into components: ``vote`` (the election, an addition of the
port: the reference leaves it in the residual), ``train`` (the
learner's fit), ``fold`` (the aggregator's intake and close) and
``gossip`` (the partial-aggregate exchange, the round-result waits and
the full-model diffusion); ``host_other`` is the residual, wall minus
everything measured. Components may overlap in wall time (a fold on a
sender's thread runs while the learning thread waits in gossip), so the
measured sum can exceed the wall; coverage is reported, not clamped.

:meth:`RoundProfiler.record_external` appends a round whose component
seconds were measured elsewhere: the engine's telemetry fan-out
(:mod:`tpfl_torch.management.engine_obs`) divides a window's measured
dispatch / train split over its rounds. :func:`module_tag` names an
architecture in those rows' ``engine:<tag>`` node.

Everything is gated by ``Settings.PROFILING_ENABLED``: off, a span is a
shared no-op and nothing is recorded. The reference's compile
observatory, cost model and HBM tracker are not ported (``ROADMAP.md``
§1 item 5).
"""

from __future__ import annotations

import os
import time
import zlib
from collections import deque
from typing import Any

from tpfl_torch.concurrency import make_lock
from tpfl_torch.management.logger import logger
from tpfl_torch.settings import Settings

#: Round attribution components; ``host_other`` is the residual.
COMPONENTS = ("vote", "train", "fold", "gossip", "host_other")

#: builtin alias — the profiler's API takes a ``round`` kwarg.
_round = round

#: The logger tag of the profiler's own messages (a pseudo-node: the
#: trace is process-wide, not owned by any one federation node).
PROFILING_RING = "_profiling"


class _RoundSpan:
    """Accumulating component timer (``with rounds.span(node, comp):``)."""

    __slots__ = ("_profiler", "_node", "_component", "_t0")

    def __init__(self, profiler: "RoundProfiler", node: str, component: str) -> None:
        self._profiler = profiler
        self._node = node
        self._component = component
        self._t0 = 0.0

    def __enter__(self) -> "_RoundSpan":
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc: object) -> None:
        self._profiler.add(self._node, self._component, time.monotonic() - self._t0)


class _NullSpan:
    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc: object) -> None:
        pass


_NULL_SPAN = _NullSpan()


class RoundProfiler:
    """Per-round wall-clock attribution: ``begin_round`` opens a node's
    window, :meth:`add` / :meth:`span` accumulate component seconds into
    it, ``end_round`` closes it, computes ``host_other`` and keeps the
    record for :meth:`attribution`; the per-component seconds also land
    in ``logger.metrics`` as ``tpfl_round_attr_seconds{node,component}``
    and the wall as ``tpfl_round_wall_seconds{node}``."""

    def __init__(self) -> None:
        self._lock = make_lock("RoundProfiler._lock")
        # guarded-by: _lock. Per node a stack of open round windows.
        self._active: dict[str, list[dict]] = {}
        # guarded-by: _lock
        self._done: deque = deque(maxlen=1024)

    def enabled(self) -> bool:
        return bool(Settings.PROFILING_ENABLED)

    def begin_round(self, node: str, round: "int | None") -> None:
        if not Settings.PROFILING_ENABLED:
            return
        with self._lock:
            self._active.setdefault(node, []).append({
                "node": node,
                "round": round if round is not None else -1,
                "t0": time.monotonic(),
                "parts": dict.fromkeys(COMPONENTS[:-1], 0.0),
            })

    def _open_record(self, node: str, round: "int | None") -> "dict | None":
        """The node's open record for ``round`` — the most recent one
        when ``round`` is None or unmatched. Caller holds ``_lock``."""
        recs = self._active.get(node)
        if not recs:
            return None
        if round is not None:
            for rec in recs:
                if rec["round"] == round:
                    return rec
        return recs[-1]

    def add(self, node: str, component: str, seconds: float,
            round: "int | None" = None) -> None:
        """Accumulate measured seconds into the node's open round (a
        no-op outside a round window: bare learner fits need no
        federation round)."""
        if not Settings.PROFILING_ENABLED or seconds <= 0:
            return
        with self._lock:
            rec = self._open_record(node, round)
            if rec is not None:
                parts = rec["parts"]
                parts[component] = parts.get(component, 0.0) + seconds

    def span(self, node: str, component: str) -> "_RoundSpan | _NullSpan":
        if not Settings.PROFILING_ENABLED:
            return _NULL_SPAN
        return _RoundSpan(self, node, component)

    def end_round(self, node: str, round: "int | None") -> "dict | None":
        if not Settings.PROFILING_ENABLED:
            return None
        now = time.monotonic()
        with self._lock:
            rec = self._open_record(node, round)
            if rec is not None:
                self._active[node].remove(rec)
                if not self._active[node]:
                    del self._active[node]
        if rec is None:
            return None
        wall = max(now - rec["t0"], 1e-9)
        parts = rec["parts"]
        measured = sum(parts.values())
        parts["host_other"] = max(0.0, wall - measured)
        record = {
            "node": node,
            "round": rec["round"],
            "wall": wall,
            "parts": parts,
            "coverage": (measured + parts["host_other"]) / wall,
            "measured_frac": measured / wall,
        }
        with self._lock:
            self._done.append(record)
        for comp, secs in parts.items():
            logger.metrics.observe("tpfl_round_attr_seconds", secs,
                                   labels={"node": node, "component": comp})
        logger.metrics.observe("tpfl_round_wall_seconds", wall, labels={"node": node})
        return record

    def record_external(self, node: str, round: "int | None", parts: dict,
                        wall: float) -> "dict | None":
        """Append one completed round record whose component seconds were
        measured elsewhere (the engine fan-out's per-round rows, marked
        ``external``): the same ``tpfl_round_*`` series as
        :meth:`end_round`, ``host_other`` the residual, and a ``round``
        span in the node's flight ring."""
        if not Settings.PROFILING_ENABLED:
            return None
        from tpfl_torch.management.telemetry import flight

        wall = max(float(wall), 1e-9)
        parts = {k: float(v) for k, v in parts.items()}
        measured = sum(parts.values())
        parts.setdefault("host_other", max(0.0, wall - measured))
        record = {
            "node": node,
            "round": int(round) if round is not None else -1,
            "wall": wall,
            "parts": parts,
            "coverage": sum(parts.values()) / wall,
            "measured_frac": measured / wall,
            "external": True,
        }
        with self._lock:
            self._done.append(record)
        for comp, secs in parts.items():
            logger.metrics.observe("tpfl_round_attr_seconds", secs,
                                   labels={"node": node, "component": comp})
        logger.metrics.observe("tpfl_round_wall_seconds", wall, labels={"node": node})
        now = time.monotonic()
        flight.record(node, {
            "kind": "span", "name": "round", "node": node, "trace": "", "t0": now - wall,
            "t1": now, "round": record["round"],
            **{f"s_{k}": _round(v, 6) for k, v in parts.items()},
        })
        return record

    def attribution(self, node: "str | None" = None) -> list[dict]:
        """Completed round records (optionally one node's), oldest first."""
        with self._lock:
            records = list(self._done)
        if node is not None:
            records = [r for r in records if r["node"] == node]
        return records

    def reset(self) -> None:
        with self._lock:
            self._active.clear()
            self._done.clear()


def module_tag(module: Any) -> str:
    """Short stable tag of an architecture: the CRC-32 of its ``repr``,
    four hex digits (the reference's ``module_tag``)."""
    return f"{zlib.crc32(repr(module).encode()) & 0xFFFF:04x}"


# --- torch.profiler trace wrap (any run) -------------------------------------

_trace_lock = make_lock("profiling._trace_lock")
# guarded-by: _trace_lock — 0 or 1 (directory, profiler) pairs
_trace: "list[tuple[str, Any]]" = []


def start_trace(directory: str) -> bool:
    """Start a process-wide ``torch.profiler`` trace (CPU, and CUDA when
    a card is present) that :func:`stop_trace` writes into
    ``directory`` (idempotent: a second start while one is active is a
    no-op — in-process nodes share one profiler). Returns True when
    this call started it."""
    if not directory:
        return False
    with _trace_lock:
        if _trace:
            return False
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            prof = profile(activities=activities)
            prof.start()
        except Exception as e:
            logger.warning(PROFILING_RING, f"torch.profiler trace failed: {e}")
            return False
        _trace.append((directory, prof))
    return True


def stop_trace() -> bool:
    """Stop the active trace, if any, and write it as
    ``<directory>/trace.json`` (Chrome trace format; idempotent)."""
    with _trace_lock:
        if not _trace:
            return False
        directory, prof = _trace.pop()
    try:
        prof.stop()
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, "trace.json")
        prof.export_chrome_trace(path)
    except Exception as e:
        logger.warning(PROFILING_RING, f"torch.profiler trace failed: {e}")
        return False
    logger.info(PROFILING_RING, f"torch.profiler trace written to {path}")
    return True


#: Process-wide singleton (one federation per process).
rounds = RoundProfiler()

__all__ = ["COMPONENTS", "RoundProfiler", "rounds", "start_trace", "stop_trace"]
