"""Adaptive async control plane — a copy of
:mod:`tpfl.learning.async_control` (framework-free): a per-node
:class:`AsyncController` observes each async round's arrivals and
re-derives the effective (K, deadline) pair the next round opens with.

Observation sources (the determinism discipline):

- **serialized mode** (``Settings.ASYNC_SERIALIZED``): arrival stamps
  come from the seeded :class:`~tpfl_torch.communication.faults
  .AsyncSchedule` **virtual clock** when one is attached, and from plain
  arrival ordinals when none is — never from the wall clock, so two
  same-seed runs feed the controller identical observation multisets and
  its K/deadline trajectories are identical at every node;
- **free-running mode**: stamps are ``time.monotonic()`` at intake.

Every per-round summary is order-invariant (stamps are sorted before
differencing, staleness is averaged), so the controller's state depends
only on the multiset of arrivals a round folded.

The tuning rule (bounds ``ASYNC_K_MIN/MAX``, ``ASYNC_CTL_EWMA``,
``ASYNC_CTL_QUANTILE``; ``ASYNC_ROUND_DEADLINE`` is the deadline
ceiling): a round that deadline-closed under-filled shrinks K toward
what arrived; a buffer that filled within half the armed deadline at low
staleness grows K by one (free-running only, never to the full fleet);
EWMA mean staleness above 2.0 sheds one; the deadline re-arms at ``K x
(inter-arrival quantile) x 4`` clamped to ``(0.5 s,
ASYNC_ROUND_DEADLINE]`` (free-running only). Each decision lands as a
``controller`` flight event and ``tpfl_async_ctl_*`` gauges. With
``Settings.ASYNC_ADAPTIVE`` off the controller returns the static knobs
and records nothing.
"""

from __future__ import annotations

from tpfl_torch.concurrency import make_lock
from tpfl_torch.management import tracing
from tpfl_torch.management.logger import logger
from tpfl_torch.settings import Settings

#: Safety margin on the quantile-derived deadline: K arrivals at the
#: tail inter-arrival cadence, times this — absorbs one straggler
#: burst without a deadline close.
_DEADLINE_MARGIN = 4.0

#: Floor on the adaptive deadline (seconds): below this the deadline
#: poll races the intake path itself.
_DEADLINE_FLOOR = 0.5

#: EWMA mean staleness above which the controller sheds K: the version
#: frontier is outrunning the fleet's trainers.
_STALENESS_PRESSURE = 2.0

#: Retained per-round decision records (the trajectory receipt).
_TRAJECTORY_CAP = 4096


def _quantile(sorted_xs: "list[float]", q: float) -> float:
    """Nearest-rank quantile of an already-sorted list (deterministic,
    no interpolation surprises across numpy versions)."""
    if not sorted_xs:
        return 0.0
    q = min(max(q, 0.0), 1.0)
    idx = min(len(sorted_xs) - 1, max(0, int(round(q * (len(sorted_xs) - 1)))))
    return float(sorted_xs[idx])


class AsyncController:
    """Per-node adaptive (K, deadline) controller for async buffered
    rounds. One per node (constructed by ``NodeState``, like the
    quarantine engine), consulted by ``AsyncRoundStage`` at round open
    and fed the round's arrival observations at round close. All
    mutable state sits under one ``make_lock`` leaf lock; telemetry
    emission happens outside it."""

    def __init__(self, node_name: str = "unknown") -> None:
        self.node_name = node_name
        self._lock = make_lock("AsyncController._lock")
        # EWMA state over per-round order-invariant summaries; None
        # until the first observed round.
        # guarded-by: _lock
        self._ia_q: "float | None" = None  # inter-arrival quantile (s)
        # guarded-by: _lock
        self._tau_mean: "float | None" = None  # mean staleness
        # Last round's outcome: close reason, arrival count, fill time
        # relative to the armed deadline.
        # guarded-by: _lock
        self._last_reason: "str | None" = None
        # guarded-by: _lock
        self._last_arrivals: int = 0
        # guarded-by: _lock
        self._last_fill_frac: "float | None" = None
        # The pair currently in force (None until the first adaptive
        # round opens).
        # guarded-by: _lock
        self._k: "int | None" = None
        # guarded-by: _lock
        self._deadline: "float | None" = None
        # Bounded per-round decision log — the deterministic trajectory
        # receipt tests/bench compare across same-seed runs.
        # guarded-by: _lock
        self._trajectory: "list[dict]" = []
        # The previous experiment's trajectory, archived by reset():
        # experiment teardown (NodeState.clear) resets the controller
        # BEFORE the harness can capture the receipt, so the receipt
        # survives one reset.
        # guarded-by: _lock
        self._last_trajectory: "list[dict]" = []

    # --- the decision point (AsyncRoundStage, round open) ---

    def round_open(
        self, round_ordinal: int, fleet_size: int
    ) -> "tuple[int, float]":
        """The (effective K, effective deadline seconds) the opening
        round should use. Static knob passthrough while
        ``Settings.ASYNC_ADAPTIVE`` is off; otherwise the tuning rule
        over the EWMA state (see module docstring), recorded in the
        trajectory and emitted as a ``controller`` flight event +
        gauges."""
        base_k = max(1, int(Settings.ASYNC_BUFFER_K))
        base_deadline = float(Settings.ASYNC_ROUND_DEADLINE)
        if not Settings.ASYNC_ADAPTIVE:
            return base_k, base_deadline
        k_min = max(1, int(Settings.ASYNC_K_MIN))
        k_max = max(k_min, int(Settings.ASYNC_K_MAX))
        fleet_cap = max(k_min, min(k_max, max(1, int(fleet_size))))
        with self._lock:
            k = self._k if self._k is not None else base_k
            k = max(k_min, min(k, fleet_cap))
            deadline = base_deadline
            if self._last_reason is not None:
                if self._last_reason == "deadline":
                    # Under-filled at the bell: ask for what arrives.
                    k = max(k_min, min(k - 1, max(self._last_arrivals, 1)))
                elif (
                    not Settings.ASYNC_SERIALIZED
                    and self._last_reason == "buffer_full"
                    and self._last_fill_frac is not None
                    and self._last_fill_frac <= 0.5
                    and (self._tau_mean or 0.0) <= _STALENESS_PRESSURE
                ):
                    # Growth is free-running only, and never to the
                    # full fleet (K = fleet is the synchronous barrier
                    # again). Under the serialized discipline a K above
                    # the operator's ASYNC_BUFFER_K can ask the reorder
                    # buffer for a fast trainer's SECOND contribution
                    # before anyone's round can close — a schedule
                    # stall only the wall-clock deadline resolves,
                    # which is exactly the nondeterminism the
                    # discipline forbids. Serialized adaptation only
                    # ever shrinks.
                    k = min(
                        max(k_min, min(fleet_cap, int(fleet_size) - 1)),
                        k + 1,
                    )
                if (self._tau_mean or 0.0) > _STALENESS_PRESSURE:
                    # Rounds are outpacing the trainers: close on fewer
                    # so the version frontier slows down.
                    k = max(k_min, k - 1)
            # Deadline adaptation needs WALL-CLOCK inter-arrivals. The
            # serialized discipline observes the virtual clock (its
            # whole point is independence from real timing), and a
            # wall deadline derived from virtual stamps could fire on
            # real-time noise — the nondeterminism the discipline
            # exists to remove. Serialized rounds therefore keep the
            # static failsafe and adapt only K.
            if (
                not Settings.ASYNC_SERIALIZED
                and self._ia_q is not None
                and self._ia_q > 0.0
            ):
                deadline = min(
                    base_deadline,
                    max(_DEADLINE_FLOOR, k * self._ia_q * _DEADLINE_MARGIN),
                )
            self._k, self._deadline = k, deadline
            record = {
                "round": int(round_ordinal),
                "k": int(k),
                "deadline": round(float(deadline), 6),
                "ia_q": round(self._ia_q, 6) if self._ia_q is not None else None,
                "tau_mean": (
                    round(self._tau_mean, 6)
                    if self._tau_mean is not None
                    else None
                ),
                "last_reason": self._last_reason,
            }
            self._trajectory.append(record)
            if len(self._trajectory) > _TRAJECTORY_CAP:
                del self._trajectory[: len(self._trajectory) - _TRAJECTORY_CAP]
        self._emit(record)
        return k, deadline

    # --- the observation intake (AsyncRoundStage, round close) ---

    def observe_round(
        self,
        round_ordinal: "int | None",
        arrivals: "list[tuple[int, float]]",
        reason: "str | None",
        armed_deadline: float,
    ) -> None:
        """Fold one closed round's arrival observations into the EWMA
        state. ``arrivals`` is the aggregator's ``(τ, stamp)`` list —
        virtual-clock stamps under the serialized discipline, monotonic
        otherwise; summaries are order-invariant (sorted before
        differencing) so only the multiset matters. No-op while
        ``Settings.ASYNC_ADAPTIVE`` is off."""
        if not Settings.ASYNC_ADAPTIVE:
            return
        alpha = min(max(float(Settings.ASYNC_CTL_EWMA), 0.01), 1.0)
        q = float(Settings.ASYNC_CTL_QUANTILE)
        stamps = sorted(s for _, s in arrivals)
        deltas = [b - a for a, b in zip(stamps, stamps[1:]) if b >= a]
        ia_q = _quantile(sorted(deltas), q) if deltas else None
        taus = [float(t) for t, _ in arrivals]
        tau_mean = (sum(taus) / len(taus)) if taus else None
        fill = (stamps[-1] - stamps[0]) if len(stamps) >= 2 else 0.0
        with self._lock:
            if ia_q is not None:
                self._ia_q = (
                    ia_q
                    if self._ia_q is None
                    else (1.0 - alpha) * self._ia_q + alpha * ia_q
                )
            if tau_mean is not None:
                self._tau_mean = (
                    tau_mean
                    if self._tau_mean is None
                    else (1.0 - alpha) * self._tau_mean + alpha * tau_mean
                )
            self._last_reason = reason
            self._last_arrivals = len(arrivals)
            self._last_fill_frac = (
                fill / armed_deadline if armed_deadline > 0 else None
            )
        _ = round_ordinal  # kept for the call-site's self-documentation

    # --- emission / query surface ---

    def _emit(self, record: dict) -> None:
        """Registry + flight emission — OUTSIDE ``_lock``."""
        labels = {"node": self.node_name}
        logger.metrics.gauge(
            "tpfl_async_ctl_k", float(record["k"]), labels=labels
        )
        logger.metrics.gauge(
            "tpfl_async_ctl_deadline_seconds",
            float(record["deadline"]),
            labels=labels,
        )
        if record["ia_q"] is not None:
            logger.metrics.gauge(
                "tpfl_async_ctl_interarrival", record["ia_q"], labels=labels
            )
        if record["tau_mean"] is not None:
            logger.metrics.gauge(
                "tpfl_async_ctl_staleness", record["tau_mean"], labels=labels
            )
        tracing.event(
            "controller", self.node_name,
            round=record["round"], k=record["k"],
            deadline=record["deadline"],
            reason=record["last_reason"] or "",
        )

    def trajectory(self) -> "list[dict]":
        """The per-round decision log (round, k, deadline, EWMA inputs)
        — the byte-stable receipt serialized same-seed runs are
        compared on. Empty after a reset; see :meth:`last_trajectory`
        for the archived previous experiment's log."""
        with self._lock:
            return [dict(r) for r in self._trajectory]

    def last_trajectory(self) -> "list[dict]":
        """The trajectory archived by the most recent :meth:`reset` —
        what post-experiment receipts read (NodeState.clear resets the
        controller at experiment teardown)."""
        with self._lock:
            return [dict(r) for r in self._last_trajectory]

    # --- checkpoint ---

    def state_export(self) -> dict:
        """Checkpointable snapshot of the learned state — EWMA inputs,
        the (K, deadline) pair in force, last-round outcome and the
        decision trajectory. Plain scalars/dicts only; a restored
        controller resumes tuning from the same EWMA point instead of
        cold."""
        with self._lock:
            return {
                "ia_q": self._ia_q,
                "tau_mean": self._tau_mean,
                "last_reason": self._last_reason,
                "last_arrivals": int(self._last_arrivals),
                "last_fill_frac": self._last_fill_frac,
                "k": self._k,
                "deadline": self._deadline,
                "trajectory": [dict(r) for r in self._trajectory],
                # The archived receipt too: a kill between reset() and
                # the harness's last_trajectory() read would lose it.
                "last_trajectory": [dict(r) for r in self._last_trajectory],
            }

    def state_import(self, state: dict) -> None:
        """Restore a :meth:`state_export` snapshot in place (the resume
        half — the trajectory picks up where the killed run left off,
        capped at the usual bound)."""
        with self._lock:
            self._ia_q = (
                float(state["ia_q"]) if state.get("ia_q") is not None else None
            )
            self._tau_mean = (
                float(state["tau_mean"])
                if state.get("tau_mean") is not None
                else None
            )
            reason = state.get("last_reason")
            self._last_reason = str(reason) if reason is not None else None
            self._last_arrivals = int(state.get("last_arrivals", 0))
            fill = state.get("last_fill_frac")
            self._last_fill_frac = float(fill) if fill is not None else None
            self._k = int(state["k"]) if state.get("k") is not None else None
            self._deadline = (
                float(state["deadline"])
                if state.get("deadline") is not None
                else None
            )
            traj = [dict(r) for r in state.get("trajectory", [])]
            self._trajectory = traj[-_TRAJECTORY_CAP:]
            last = [dict(r) for r in state.get("last_trajectory", [])]
            self._last_trajectory = last[-_TRAJECTORY_CAP:]

    def reset(self) -> None:
        """Drop all learned state (a controller belongs to one
        experiment; NodeState.clear calls this at teardown). The
        decision log survives one reset as :meth:`last_trajectory`."""
        with self._lock:
            self._ia_q = None
            self._tau_mean = None
            self._last_reason = None
            self._last_arrivals = 0
            self._last_fill_frac = None
            self._k = None
            self._deadline = None
            if self._trajectory:
                self._last_trajectory = [dict(r) for r in self._trajectory]
            self._trajectory.clear()
