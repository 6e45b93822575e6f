"""Deterministic fault injection for chaos-testing the federation — a
copy of :mod:`tpfl.communication.faults`.

A :class:`FaultInjector` attaches to any
:class:`~tpfl_torch.communication.base.ThreadedCommunicationProtocol`
and applies a declarative :class:`FaultPlan` — per-link message drop,
delay, duplication and payload corruption, plus timed peer crash and
partition windows — with every probabilistic decision drawn from a
**per-link RNG stream** seeded from ``(seed, src, dst)``. Two runs with
the same ``(seed, plan)`` therefore make identical per-link fault
decisions regardless of cross-link thread interleaving, and the
injector's counters (delivered / dropped / corrupted / blocked per
link) come out identical — and equal to the reference's for the same
seed, plan and sequence of links.

Injection points (wired in ``base.py``):

- outbound: every send attempt (including each retry — a lossy link
  re-rolls per attempt, like a real network) consults
  :meth:`FaultInjector.decide`;
- corruption is delivered through the transport's
  ``_transport_send_corrupted`` hook; the in-memory transport passes
  objects by reference, so that hook simulates the receiver's rejection
  (the reference's gRPC transport flips a byte under its chunk CRC);
- inbound: a crashed node's ``handle_message`` drops everything
  (:meth:`FaultInjector.is_down`).

The injector is test/bench machinery: a production node simply never
attaches one (``protocol._fault_injector is None`` — zero overhead on
the send path beyond the None check). :class:`TrainerSpeedPlan` is the
trainer-speed chaos spec, and :class:`AsyncSchedule` the seeded total
order the serialized asynchronous rounds admit contributions in, built
from the same plan.
"""

from __future__ import annotations

import heapq
import random
import threading
import time
import zlib
from dataclasses import dataclass, field
from typing import Any, Iterable, Optional

from tpfl_torch.settings import Settings

WILDCARD = "*"


@dataclass
class LinkFaults:
    """Faults applied to one directed link (or a wildcard pattern).

    Probabilities are per send *attempt*. ``drop_limit`` /
    ``corrupt_limit`` bound the total number of injected faults on the
    link — handy for tests that want "the first N attempts fail, then
    the wire heals" without racing a probability."""

    drop: float = 0.0
    corrupt: float = 0.0
    duplicate: float = 0.0
    delay: float = 0.0
    delay_jitter: float = 0.0
    drop_limit: Optional[int] = None
    corrupt_limit: Optional[int] = None


@dataclass
class CrashWindow:
    """Peer ``addr`` is down from ``start`` to ``end`` seconds after the
    injector clock starts (``end=None`` = never recovers). While down,
    its sends are blocked and its inbound handling drops everything."""

    addr: str
    start: float = 0.0
    end: Optional[float] = None

    def active(self, t: float) -> bool:
        return t >= self.start and (self.end is None or t < self.end)


@dataclass
class Partition:
    """Links crossing between two (or more) address groups are blocked
    during the window. Addresses outside every group are unaffected."""

    groups: tuple[frozenset[str], ...]
    start: float = 0.0
    end: Optional[float] = None

    def active(self, t: float) -> bool:
        return t >= self.start and (self.end is None or t < self.end)

    def blocks(self, src: str, dst: str) -> bool:
        gs = gd = None
        for i, g in enumerate(self.groups):
            if src in g:
                gs = i
            if dst in g:
                gd = i
        return gs is not None and gd is not None and gs != gd


class FaultPlan:
    """Declarative fault plan: link rules + crash/partition schedules.

    ``links`` maps ``(src, dst)`` patterns (either side may be ``"*"``)
    to :class:`LinkFaults`; the most specific match wins — exact, then
    ``(src, "*")``, then ``("*", dst)``, then ``("*", "*")``."""

    def __init__(
        self,
        links: Optional[dict[tuple[str, str], LinkFaults]] = None,
        crashes: Optional[Iterable[CrashWindow]] = None,
        partitions: Optional[Iterable[Partition]] = None,
    ) -> None:
        self.links = dict(links or {})
        self.crashes = list(crashes or [])
        self.partitions = list(partitions or [])

    def faults_for(self, src: str, dst: str) -> Optional[LinkFaults]:
        for key in (
            (src, dst),
            (src, WILDCARD),
            (WILDCARD, dst),
            (WILDCARD, WILDCARD),
        ):
            hit = self.links.get(key)
            if hit is not None:
                return hit
        return None

    @classmethod
    def from_dict(cls, spec: dict[str, Any]) -> "FaultPlan":
        """Build a plan from the documented schema (docs/protocol.md):

        .. code-block:: python

            {"links": {"a->b": {"drop": 0.2, "delay": 0.05},
                       "*->*": {"corrupt": 0.01}},
             "crashes": [{"addr": "c", "start": 5.0, "end": 30.0}],
             "partitions": [{"groups": [["a"], ["b", "c"]],
                             "start": 10.0, "end": 20.0}]}
        """
        links: dict[tuple[str, str], LinkFaults] = {}
        for key, f in (spec.get("links") or {}).items():
            src, _, dst = key.partition("->")
            if not dst:
                raise ValueError(f"Link key {key!r} must be 'src->dst'")
            links[(src.strip(), dst.strip())] = LinkFaults(**f)
        crashes = [CrashWindow(**c) for c in spec.get("crashes") or []]
        partitions = [
            Partition(
                groups=tuple(frozenset(g) for g in p["groups"]),
                start=p.get("start", 0.0),
                end=p.get("end"),
            )
            for p in spec.get("partitions") or []
        ]
        return cls(links=links, crashes=crashes, partitions=partitions)


@dataclass
class Decision:
    """Outcome of one send attempt: ``action`` in {"deliver", "drop",
    "corrupt", "block"}; ``copies`` > 1 duplicates the delivery;
    ``delay`` seconds are slept before delivering."""

    action: str = "deliver"
    copies: int = 1
    delay: float = 0.0


@dataclass
class _LinkState:
    rng: random.Random
    drops: int = 0
    corrupts: int = 0
    counters: dict[str, int] = field(default_factory=dict)


class FaultInjector:
    """Applies a :class:`FaultPlan` deterministically.

    The clock for crash/partition windows is ``time.monotonic()``
    anchored at the first decision (or an explicit :meth:`start`);
    :meth:`crash` / :meth:`revive` override schedules for tests and
    round-driven harnesses that want exact (non-wall-clock) timing.
    """

    def __init__(self, plan: FaultPlan, seed: Optional[int] = None) -> None:
        self.plan = plan
        self.seed = (Settings.SEED or 0) if seed is None else seed
        self._links: dict[tuple[str, str], _LinkState] = {}
        self._lock = threading.Lock()
        self._epoch: Optional[float] = None
        self._manual_down: set[str] = set()

    # --- lifecycle / wiring ---

    def attach(self, protocol: Any) -> Any:
        """Install on a protocol (sets ``protocol._fault_injector``).
        Returns the protocol for chaining."""
        protocol._fault_injector = self
        return protocol

    def start(self) -> "FaultInjector":
        """Anchor the schedule clock now (idempotent)."""
        with self._lock:
            if self._epoch is None:
                self._epoch = time.monotonic()
        return self

    def elapsed(self) -> float:
        with self._lock:
            if self._epoch is None:
                self._epoch = time.monotonic()
            return time.monotonic() - self._epoch

    # --- manual crash control (deterministic round-driven harnesses) ---

    def crash(self, addr: str) -> None:
        with self._lock:
            self._manual_down.add(addr)
        # Post-mortem hook: an injected crash is exactly the failure
        # the flight recorder exists for — record it and flush the
        # victim's ring (a JSON dump lands in
        # Settings.TELEMETRY_DUMP_DIR when set, traceview-readable).
        # The reference also aborts the victim's engine window pipeline
        # here; the port has no window pipeline (ROADMAP.md §1 item 4).
        from tpfl_torch.management import tracing
        from tpfl_torch.management.telemetry import flight

        tracing.event("crash_injected", addr)
        flight.dump(addr, "crash")

    def revive(self, addr: str) -> None:
        with self._lock:
            self._manual_down.discard(addr)

    # --- queries ---

    def is_down(self, addr: str) -> bool:
        with self._lock:
            if addr in self._manual_down:
                return True
        if not self.plan.crashes:
            return False
        t = self.elapsed()
        return any(c.addr == addr and c.active(t) for c in self.plan.crashes)

    def link_blocked(self, src: str, dst: str) -> bool:
        if self.is_down(src) or self.is_down(dst):
            return True
        if not self.plan.partitions:
            return False
        t = self.elapsed()
        return any(p.active(t) and p.blocks(src, dst) for p in self.plan.partitions)

    # --- the decision point ---

    def _link(self, src: str, dst: str) -> _LinkState:
        key = (src, dst)
        st = self._links.get(key)
        if st is None:
            # Stable per-link stream: independent of creation order and
            # of every other link's draw count.
            lseed = self.seed ^ zlib.crc32(f"{src}->{dst}".encode())
            st = self._links[key] = _LinkState(rng=random.Random(lseed))
        return st

    def decide(self, src: str, dst: str) -> Decision:
        """Fault decision for one send attempt on ``src -> dst``.
        Consumes the link's RNG stream; counts the outcome."""
        if self.link_blocked(src, dst):
            self.count(src, dst, "blocked")
            return Decision(action="block")
        f = self.plan.faults_for(src, dst)
        if f is None:
            self.count(src, dst, "clean")
            return Decision()
        with self._lock:
            st = self._link(src, dst)
            if f.drop > 0 and st.rng.random() < f.drop:
                if f.drop_limit is None or st.drops < f.drop_limit:
                    st.drops += 1
                    st.counters["dropped"] = st.counters.get("dropped", 0) + 1
                    return Decision(action="drop")
            if f.corrupt > 0 and st.rng.random() < f.corrupt:
                if f.corrupt_limit is None or st.corrupts < f.corrupt_limit:
                    st.corrupts += 1
                    st.counters["corrupted"] = st.counters.get("corrupted", 0) + 1
                    return Decision(action="corrupt")
            copies = 1
            if f.duplicate > 0 and st.rng.random() < f.duplicate:
                copies = 2
                st.counters["duplicated"] = st.counters.get("duplicated", 0) + 1
            delay = f.delay
            if f.delay_jitter > 0:
                delay += st.rng.random() * f.delay_jitter
            return Decision(copies=copies, delay=delay)

    # --- bookkeeping ---

    def count(self, src: str, dst: str, key: str, n: int = 1) -> None:
        with self._lock:
            c = self._link(src, dst).counters
            c[key] = c.get(key, 0) + n

    def stats(self) -> dict[str, dict[str, int]]:
        """``"src->dst" -> {counter: n}`` snapshot."""
        with self._lock:
            return {
                f"{src}->{dst}": dict(st.counters)
                for (src, dst), st in self._links.items()
            }

    def reset_stats(self) -> None:
        """Zero the counters (the RNG streams and fault limits keep
        their position — this is for per-round windows, not replays)."""
        with self._lock:
            for st in self._links.values():
                st.counters = {}


# --- trainer-speed chaos + the async serialization discipline -------------


class TrainerSpeedPlan:
    """Declarative seeded trainer-speed skew: ``addr -> fit delay``
    (seconds slept around every local fit — the chaos knob that makes
    heterogeneous fleets reproducible). The SAME plan seeds the
    :class:`AsyncSchedule` that serializes async arrival order. Pure data: the
    learner wrapping lives in ``tpfl_torch.attacks.plan`` (layering —
    this module cannot import the learning layer)."""

    def __init__(
        self, delays: dict[str, float], seed: Optional[int] = None
    ) -> None:
        # unguarded: plan config — built once, read-only after
        # construction (wrappers and schedules only read).
        self.delays = dict(delays)
        self._seed = seed

    @property
    def seed(self) -> int:
        """Plan seed (falls back to Settings.SEED at use time — the
        FaultInjector convention)."""
        return (Settings.SEED or 0) if self._seed is None else self._seed

    @classmethod
    def skewed(
        cls,
        addrs: Iterable[str],
        slow_frac: float = 0.2,
        base_delay: float = 0.05,
        skew: float = 10.0,
        seed: Optional[int] = None,
    ) -> "TrainerSpeedPlan":
        """A seeded ``skew``-times-slower tail: ``slow_frac`` of the
        (sorted) addresses — drawn by the plan RNG — sleep
        ``base_delay * skew`` per fit, the rest ``base_delay``."""
        plan = cls({}, seed=seed)
        ordered = sorted(addrs)
        n_slow = max(1, round(slow_frac * len(ordered))) if ordered else 0
        slow = set(random.Random(plan.seed).sample(ordered, n_slow))
        plan.delays = {
            a: base_delay * (skew if a in slow else 1.0) for a in ordered
        }
        return plan

    def delay_for(self, addr: str) -> float:
        return float(self.delays.get(addr, 0.0))


class AsyncSchedule:
    """Seeded total order over async contributions — the serialized
    arrival discipline (``Settings.ASYNC_SERIALIZED``).

    Built from per-trainer periods (a :class:`TrainerSpeedPlan`'s
    delays), the schedule assigns contribution ``c`` of trainer ``t``
    the virtual finish time ``(c+1) * period(t)`` and orders all
    contributions by ``(virtual time, seeded trainer rank)``. An
    aggregator holding out-of-order arrivals in a reorder buffer and
    folding strictly in this order folds an identical sequence at
    every node and in every same-seed run. Because the periods mirror
    the real (injected) trainer speeds, actual arrival order tracks
    schedule order and the reorder buffer rarely waits.

    Stateful consumer-side: each aggregator takes its OWN instance
    (:meth:`fork`) — same ``(periods, seed)`` ⇒ same order everywhere.
    """

    def __init__(
        self, periods: dict[str, float], seed: Optional[int] = None
    ) -> None:
        # unguarded: all mutable state is owned by one Aggregator and
        # accessed under its _lock (the schedule is handed over whole).
        self._seed = seed
        self.periods = {
            a: max(float(p), 1e-3) for a, p in dict(periods).items()
        }
        ordered = sorted(self.periods)
        # Seeded rank breaks virtual-time ties between equal-period
        # trainers without depending on address sort order alone.
        rng = random.Random(
            ((Settings.SEED or 0) if seed is None else seed) ^ 0x5EED
        )
        shuffled = list(ordered)
        rng.shuffle(shuffled)
        self._rank = {a: i for i, a in enumerate(shuffled)}
        self._heap: list[tuple[float, int, str]] = [
            (self.periods[a], self._rank[a], a) for a in ordered
        ]
        heapq.heapify(self._heap)

    @classmethod
    def for_plan(cls, plan: TrainerSpeedPlan) -> "AsyncSchedule":
        return cls(plan.delays, seed=plan.seed)

    def fork(self) -> "AsyncSchedule":
        """A fresh same-order instance (one per aggregator)."""
        return AsyncSchedule(self.periods, seed=self._seed)

    def knows(self, addr: str) -> bool:
        return addr in self.periods

    def expected(self) -> Optional[str]:
        """The trainer whose contribution is next in schedule order
        (None for an empty schedule)."""
        return self._heap[0][2] if self._heap else None

    def expected_time(self) -> Optional[float]:
        """The head contribution's VIRTUAL finish time — the seeded
        clock the adaptive controller's serialized-mode observations
        derive from."""
        return self._heap[0][0] if self._heap else None

    def advance(self) -> None:
        """Consume the head (its contribution was admitted) and
        schedule that trainer's next contribution."""
        if not self._heap:
            return
        vt, rank, addr = heapq.heappop(self._heap)
        heapq.heappush(self._heap, (vt + self.periods[addr], rank, addr))

    def skip(self) -> Optional[str]:
        """Liveness escape: advance past the head WITHOUT a
        contribution (deadline close on a dead trainer). Breaks the
        byte-determinism guarantee for this run — the caller logs it."""
        head = self.expected()
        self.advance()
        return head
