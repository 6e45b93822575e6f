"""Lock construction + opt-in runtime lock-order tracing — a copy of the
lock half of :mod:`tpfl.concurrency`.

Every lock of the port's threaded core (``Aggregator``, ``BufferPool``,
the logger's metric registry) is built through :func:`make_lock`, so one
switch — ``Settings.LOCK_TRACING`` — swaps plain ``threading.Lock``
objects for :class:`TracedLock` wrappers that record the RUNTIME
lock-acquisition graph: every time a thread acquires lock B while
holding lock A, the edge A→B is recorded with the acquiring thread's
name as witness. A cycle is a deadlock waiting for the right
interleaving; :meth:`LockGraph.find_cycle` returns the witness chain.

Tracing is OFF by default: ``make_lock`` reads the setting at LOCK
CREATION time, so enabling it means setting ``Settings.LOCK_TRACING =
True`` before the objects are built.

The trace contracts (``Settings.TRACE_CONTRACTS``, the other half of
:mod:`tpfl.concurrency`) guard the engine's program cache:
:func:`stamp_contract` wraps a freshly built window program with the knob
values its cache key encodes, and :func:`check_contract` holds that stamp
to the values a dispatch resolves, so a key that lost an axis fails at
dispatch with a named witness instead of serving a stale program.
"""

from __future__ import annotations

import threading
from typing import Optional, Union

from tpfl_torch.settings import Settings


class LockOrderError(RuntimeError):
    """The recorded lock-acquisition graph contains a cycle (a latent
    deadlock); the message carries the witness chain."""


class LockGraph:
    """Process-wide acquisition-order graph recorded by TracedLock.

    Nodes are lock NAMES (e.g. ``"Neighbors._lock"``), so all instances
    of a class share one node — exactly the granularity deadlock
    analysis needs: two *different* Neighbors tables locked in opposite
    orders by two threads deadlock just as surely as one.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # (held, acquired) -> witness: name of first thread that did it.
        self._edges: dict[tuple[str, str], str] = {}
        self._threads: set[str] = set()

    def record(self, held: str, acquired: str, thread_name: str) -> None:
        if held == acquired:
            return  # same-name re-acquire is a self-deadlock, not an order
        with self._lock:
            self._edges.setdefault((held, acquired), thread_name)

    def note_thread(self, thread_name: str) -> None:
        with self._lock:
            self._threads.add(thread_name)

    def edges(self) -> dict[tuple[str, str], str]:
        with self._lock:
            return dict(self._edges)

    def thread_names(self) -> set[str]:
        """Names of every thread that acquired a traced lock."""
        with self._lock:
            return set(self._threads)

    def clear(self) -> None:
        with self._lock:
            self._edges.clear()
            self._threads.clear()

    def find_cycle(self) -> Optional[list[tuple[str, str, str]]]:
        """Return a witness chain ``[(held, acquired, thread), ...]``
        forming a cycle, or None when the graph is acyclic."""
        edges = self.edges()
        adj: dict[str, list[str]] = {}
        for (a, b), _ in edges.items():
            adj.setdefault(a, []).append(b)
        WHITE, GREY, BLACK = 0, 1, 2
        color: dict[str, int] = {}
        parent: dict[str, str] = {}

        def dfs(u: str) -> Optional[list[str]]:
            color[u] = GREY
            for v in adj.get(u, []):
                c = color.get(v, WHITE)
                if c == GREY:
                    # Walk parents back from u to v: the cycle.
                    chain = [u]
                    while chain[-1] != v:
                        chain.append(parent[chain[-1]])
                    chain.reverse()
                    chain.append(v)  # close the loop: v ... u -> v
                    return chain
                if c == WHITE:
                    parent[v] = u
                    found = dfs(v)
                    if found is not None:
                        return found
            color[u] = BLACK
            return None

        for node in list(adj):
            if color.get(node, WHITE) == WHITE:
                chain = dfs(node)
                if chain is not None:
                    return [
                        (a, b, edges[(a, b)])
                        for a, b in zip(chain, chain[1:])
                    ]
        return None

    def assert_acyclic(self) -> None:
        """Raise :class:`LockOrderError` with the witness chain if the
        recorded acquisition graph has a cycle."""
        cycle = self.find_cycle()
        if cycle is not None:
            parts = [cycle[0][0]]
            for _, b, thread in cycle:
                parts.append(f"-[{thread}]-> {b}")
            raise LockOrderError(
                "lock acquisition cycle (latent deadlock): "
                + " ".join(parts)
            )


#: Process-wide graph all TracedLocks feed (one federation per process
#: in every simulation mode, so a global is the right scope).
lock_graph = LockGraph()

# Per-thread stack of traced-lock names currently held.
_held = threading.local()


def _held_stack() -> list[str]:
    stack = getattr(_held, "stack", None)
    if stack is None:
        stack = _held.stack = []
    return stack


class TracedLock:
    """``threading.Lock`` wrapper that records acquisition order.

    Drop-in for the plain-Lock surface tpfl uses (``acquire`` /
    ``release`` / ``locked`` / context manager). NOT reentrant, exactly
    like the Lock it wraps."""

    __slots__ = ("name", "_lock")

    def __init__(self, name: str) -> None:
        self.name = name
        self._lock = threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._lock.acquire(blocking, timeout)
        if got:
            stack = _held_stack()
            thread_name = threading.current_thread().name
            lock_graph.note_thread(thread_name)
            for held in stack:
                lock_graph.record(held, self.name, thread_name)
            stack.append(self.name)
        return got

    def release(self) -> None:
        stack = _held_stack()
        # Remove the most recent occurrence (locks are non-reentrant,
        # but unlock order is not required to mirror lock order).
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] == self.name:
                del stack[i]
                break
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc: object) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"TracedLock({self.name!r}, locked={self.locked()})"


def make_lock(name: str) -> Union[threading.Lock, TracedLock]:
    """Build a lock named for trace reports (``"ClassName._lock"``).

    Returns a plain ``threading.Lock`` unless ``Settings.LOCK_TRACING``
    is on at CREATION time — production pays zero overhead, and traced
    runs get named locks in every deadlock witness chain."""
    if Settings.LOCK_TRACING:
        return TracedLock(name)
    return threading.Lock()


# --- trace contracts ---------------------------------------------------------


class TraceContractError(RuntimeError):
    """A cached window program was dispatched under knob values that differ
    from the ones its cache key was built from: a cache key lost an axis,
    and a STALE program was about to run. The message names the offending
    knob(s) and both values."""


class ContractedProgram:
    """Callable wrapper stamping a cached program with the knob values its
    cache key encodes (:func:`stamp_contract`). Dispatch re-checks the
    stamp against the live resolved values (:func:`check_contract`). Like
    :class:`TracedLock` it is only built while the debug knob is on.

    Attribute access forwards to the wrapped program; ``contract`` is the
    stamp itself."""

    __slots__ = ("fn", "contract")

    def __init__(self, fn: object, contract: dict) -> None:
        self.fn = fn
        self.contract = dict(contract)

    def __call__(self, *args: object, **kwargs: object) -> object:
        return self.fn(*args, **kwargs)  # type: ignore[operator]

    def __getattr__(self, name: str) -> object:
        return getattr(self.fn, name)

    def __repr__(self) -> str:
        return f"ContractedProgram({self.contract!r})"


def stamp_contract(fn: object, contract: dict) -> object:
    """Wrap a freshly built cached program with the knob values its cache
    key was built from. Returns ``fn`` itself unless
    ``Settings.TRACE_CONTRACTS`` is on at BUILD time."""
    if Settings.TRACE_CONTRACTS:
        return ContractedProgram(fn, contract)
    return fn


def check_contract(fn: object, live: dict) -> None:
    """Hold a cache-fetched program's stamped knob values to the live
    per-dispatch values. An unstamped callable (contracts off at build
    time) passes; a mismatch raises :class:`TraceContractError` with a
    named witness per knob."""
    contract = getattr(fn, "contract", None)
    if not isinstance(contract, dict):
        return
    mismatches = [(k, v, live[k]) for k, v in sorted(contract.items())
                  if k in live and live[k] != v]
    if mismatches:
        parts = ", ".join(f"{k}: compiled under {v!r}, live value {lv!r}"
                          for k, v, lv in mismatches)
        raise TraceContractError(
            "stale compiled program: the cache key is not total over the knobs it "
            f"serves — {parts} (every knob a dispatch resolves must be an axis of the "
            "program-cache key)")


__all__ = ["ContractedProgram", "LockGraph", "LockOrderError", "TraceContractError",
           "TracedLock", "check_contract", "lock_graph", "make_lock", "stamp_contract"]
