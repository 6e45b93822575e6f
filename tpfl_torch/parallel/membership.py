"""MembershipView — elastic membership over the engine's padded node
axis, the port of :mod:`tpfl.parallel.membership`.

The engine's node-stacked state is shaped for a CAPACITY TIER
(:func:`~tpfl_torch.parallel.mesh.capacity_tier`: power-of-two buckets
with a floor), not for the live member count. This view maps live peer
addresses to stable slots of that axis, so every membership event —

- **join**: a fresh peer takes the lowest free slot (a rejoining peer
  finds its row where its state already is);
- **leave / crash**: the slot returns to the free list and its fold
  weight drops to zero (the row's stale params ride along at weight
  zero, like pad rows);
- **quarantine / readmit**: the verdict flips the slot's weight and the
  slot is kept —

is an edit of the ``[capacity]`` weight vector (:meth:`weights`). Churn
inside a tier leaves the engine's tensors as they are: only crossing a
tier boundary (a promotion in :meth:`join`, a demotion in
:meth:`maybe_resize`) makes the engine resize its node axis
(``FederationEngine.sync_membership``). The reference's rule is the same
with compiled programs in place of tensors: churn inside a tier never
recompiles.

Churn arrives from protocol threads while the fit thread reads the mask
between windows: all mutable state sits under one lock.
"""

from __future__ import annotations

import heapq
from typing import Any, Optional

import numpy as np

from tpfl_torch.concurrency import make_lock
from tpfl_torch.parallel.mesh import capacity_tier
from tpfl_torch.settings import Settings

#: Demotion hysteresis: a tier is shed only once the live count falls
#: to a QUARTER of capacity (i.e. the demoted tier would still be at
#: most half full) — join/leave flapping around a boundary must not
#: oscillate resizes.
_DEMOTE_FILL = 0.25

#: Retained tier-change records (the promotions-only receipt).
_TIER_LOG_CAP = 1024


class MembershipView:
    """Live peer addrs → stable padded slots at a pow-2 capacity tier.

    Args:
        addrs: initial members (joined in order, slots 0..n-1).
        capacity_min: tier floor; defaults to
            ``Settings.ELASTIC_CAPACITY_MIN``.
        node: owner tag for telemetry/debug.
    """

    def __init__(
        self,
        addrs: "tuple[str, ...] | list[str]" = (),
        capacity_min: Optional[int] = None,
        node: str = "membership",
    ) -> None:
        self.node = node
        self._cap_min = int(
            Settings.ELASTIC_CAPACITY_MIN
            if capacity_min is None
            else capacity_min
        )
        self._lock = make_lock("MembershipView._lock")
        # addr -> padded slot index (< capacity).
        # guarded-by: _lock
        self._slots: dict[str, int] = {}
        # Freed slot heap — lowest-slot reuse keeps the live rows dense
        # at the front of the padded axis.
        # guarded-by: _lock
        self._free: list[int] = []
        # Slotted but weight-masked to zero (verdicts flow into the
        # mask, never restack state).
        # guarded-by: _lock
        self._quarantined: set[str] = set()
        # Bounded tier-change log ({"kind","capacity","live"}) — the
        # the tier moves a run is held to.
        # guarded-by: _lock
        self._tier_log: list[dict] = []
        # guarded-by: _lock — next never-used slot ordinal.
        self._next = 0
        self.capacity = capacity_tier(len(addrs), self._cap_min)
        for a in addrs:
            self.join(a)

    # --- churn events ----------------------------------------------------

    def join(self, addr: str) -> int:
        """Admit ``addr``; returns its slot. Idempotent for a live
        member. When every slot is taken the tier PROMOTES (capacity
        doubles) — the one churn event that resizes the engine."""
        with self._lock:
            slot = self._slots.get(addr)
            if slot is not None:
                return slot
            if self._free:
                slot = heapq.heappop(self._free)
            else:
                slot = self._next
                self._next += 1
                if slot >= self.capacity:
                    self.capacity = capacity_tier(slot + 1, self._cap_min)
                    self._log_tier("promote")
            self._slots[addr] = slot
            return slot

    def leave(self, addr: str) -> Optional[int]:
        """Graceful departure: the slot returns to the free list (its
        stale row rides at zero weight). Returns the freed slot, or
        None for an unknown addr."""
        with self._lock:
            slot = self._slots.pop(addr, None)
            if slot is not None:
                heapq.heappush(self._free, slot)
            self._quarantined.discard(addr)
            return slot

    def crash(self, addr: str) -> Optional[int]:
        """Crash eviction — identical mask edit to :meth:`leave` (the
        fault injector's path; the distinction is for the caller's
        bookkeeping, not the mask's)."""
        return self.leave(addr)

    def quarantine(self, addr: str) -> bool:
        """Zero ``addr``'s fold weight, KEEPING its slot — readmission
        is another mask edit away. False for a non-member."""
        with self._lock:
            if addr not in self._slots:
                return False
            self._quarantined.add(addr)
            return True

    def readmit(self, addr: str) -> bool:
        with self._lock:
            if addr not in self._quarantined:
                return False
            self._quarantined.discard(addr)
            return True

    def apply_verdicts(self, quarantined: "set[str]") -> None:
        """Reconcile with a :class:`~tpfl_torch.management.quarantine
        .QuarantineEngine`'s active set (``quarantined()``): members in
        the set are masked, members no longer in it are readmitted —
        the verdict→mask seam the learner calls between windows."""
        with self._lock:
            self._quarantined = {a for a in quarantined if a in self._slots}

    # --- the mask --------------------------------------------------------

    def weights(
        self, base: "Optional[dict[str, float]]" = None
    ) -> np.ndarray:
        """The ``[capacity]`` f32 fold-weight vector: ``base``'s weight
        (default 1.0) at each live, non-quarantined member's slot, 0.0
        everywhere else — free slots, departed peers and quarantined
        members all read as pad rows to the engine's fold."""
        with self._lock:
            w = np.zeros((self.capacity,), np.float32)
            for addr, slot in self._slots.items():
                if addr in self._quarantined:
                    continue
                w[slot] = 1.0 if base is None else float(base.get(addr, 1.0))
        return w

    def mask(self) -> np.ndarray:
        """Alias of :meth:`weights` with unit weights."""
        return self.weights()

    # --- queries ---------------------------------------------------------

    def slot_of(self, addr: str) -> Optional[int]:
        with self._lock:
            return self._slots.get(addr)

    def members(self) -> "dict[str, int]":
        """addr -> slot snapshot (live members, quarantined included)."""
        with self._lock:
            return dict(self._slots)

    def quarantined(self) -> "set[str]":
        with self._lock:
            return set(self._quarantined)

    @property
    def live(self) -> int:
        """Live member count (quarantined members still hold slots)."""
        with self._lock:
            return len(self._slots)

    def tier_events(self) -> "list[dict]":
        with self._lock:
            return [dict(e) for e in self._tier_log]

    def promotions(self) -> int:
        """Tier promotions so far."""
        with self._lock:
            return sum(1 for e in self._tier_log if e["kind"] == "promote")

    # --- tier control ----------------------------------------------------

    def maybe_resize(self, controller: Optional[Any] = None) -> Optional[int]:
        """Demote the capacity tier when the fleet has durably shrunk
        (live ≤ capacity × 0.25 — the demoted tier stays ≤ half full,
        so boundary flapping can't oscillate resizes). When an
        :class:`~tpfl_torch.learning.async_control.AsyncController` is
        handed in, demotion DEFERS under staleness pressure: a fleet
        whose trainers already lag the version frontier should not eat
        a resize on top. Returns the new capacity, or None
        when the tier holds. (Promotion happens eagerly in
        :meth:`join` — a member with no slot cannot wait.)"""
        tau = None
        if controller is not None:
            try:
                tau = controller.state_export().get("tau_mean")
            except Exception:
                tau = None
        with self._lock:
            used = len(self._slots)
            target = capacity_tier(used, self._cap_min)
            if target >= self.capacity:
                return None
            if used > self.capacity * _DEMOTE_FILL:
                return None
            if tau is not None and float(tau) > 2.0:
                return None  # staleness pressure: hold the tier
            # Compact: reassign live members (sorted by old slot) into
            # 0..n-1 so every slot fits the demoted tier.
            order = sorted(self._slots.items(), key=lambda kv: kv[1])
            self._slots = {addr: i for i, (addr, _) in enumerate(order)}
            self._free = []
            self._next = len(self._slots)
            self.capacity = target
            self._log_tier("demote")
            return target

    def _log_tier(self, kind: str) -> None:
        """Caller holds ``self._lock``."""
        self._tier_log.append(
            {"kind": kind, "capacity": int(self.capacity),
             "live": len(self._slots)}
        )
        if len(self._tier_log) > _TIER_LOG_CAP:
            del self._tier_log[: len(self._tier_log) - _TIER_LOG_CAP]

    # --- checkpoint ------------------------------------------------------

    def state_export(self) -> dict:
        """Checkpointable snapshot (host scalars/dicts only) — rides
        the engine checkpoint so a resumed host rebuilds the same
        addr→slot map (slot stability survives preemption)."""
        with self._lock:
            return {
                "capacity": int(self.capacity),
                "cap_min": int(self._cap_min),
                "slots": dict(self._slots),
                "free": sorted(self._free),
                "quarantined": sorted(self._quarantined),
                "next": int(self._next),
                "tier_log": [dict(e) for e in self._tier_log],
            }

    def state_import(self, state: dict) -> None:
        """Restore a :meth:`state_export` snapshot in place."""
        with self._lock:
            self.capacity = int(state["capacity"])
            self._cap_min = int(state.get("cap_min", self._cap_min))
            self._slots = {str(k): int(v) for k, v in state["slots"].items()}
            self._free = list(int(s) for s in state.get("free", []))
            heapq.heapify(self._free)
            self._quarantined = set(state.get("quarantined", []))
            self._next = int(state.get("next", len(self._slots)))
            self._tier_log = [dict(e) for e in state.get("tier_log", [])]

    @classmethod
    def from_state(cls, state: dict, node: str = "membership") -> "MembershipView":
        view = cls(capacity_min=int(state.get("cap_min", 1)), node=node)
        view.state_import(state)
        return view
